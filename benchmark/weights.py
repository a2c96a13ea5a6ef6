"""Seeded darknet-form weights of a configuration, drawn on the device.

The rule of the port's ``models.engine.init_params``, drawn here with a
``torch.Generator`` on the card in a few large calls (one per kind of
value, every layer's share cut from it) instead of layer by layer on the
host, so that set-up stays short. Both sides get these same tensors: the
program through its own loading path, the reference as they are.

Per convolution with batch norm: w ~ N(0, 1) * sqrt(2 / fan_in), gamma ~
U(0.8 g, 1.2 g) with g = 0.15 on the last conv of a residual branch (the
one before a shortcut) and 1 elsewhere, beta and the running mean ~ 0.1 *
N(0, 1), the running variance ~ U(0.8, 1.2). A head convolution (the one
before a detect layer): w ~ N(0, 1) * sqrt(0.5 / fan_in), bias ~ 0.1 *
N(0, 1). Random weights at full depth then give head logits of order one.
"""

from __future__ import annotations

import torch


def conv_shapes(layers, input_size: int):
    """[(layer index, cin, cout, k, stride, h_in)] of every convolution,
    from the layer list and the input size."""
    shapes, chans, sides = [], [], []
    c, h = 3, input_size
    for i, lay in enumerate(layers):
        t = lay["type"]
        if t == "conv":
            k, s = lay["size"], lay["stride"]
            shapes.append((i, c, lay["filters"], k, s, h))
            c, h = lay["filters"], (h + 2 * (k // 2) - k) // s + 1
        elif t == "route":
            refs = [r + i if r < 0 else r for r in lay["layers"]]
            c, h = sum(chans[r] for r in refs), sides[refs[0]]
        elif t == "upsample":
            h *= lay["stride"]
        elif t == "maxpool":
            h = -(-h // lay["stride"]) if lay["size"] != lay["stride"] \
                else h // lay["stride"]
        elif t == "reorg":
            c, h = c * lay["stride"] ** 2, h // lay["stride"]
        chans.append(c)
        sides.append(h)
    return shapes


def draw(cfg, seed: int, device):
    """{layer index: {"w", "gamma", "beta", "mean", "var"} or {"w", "b"}}
    of float32 tensors on ``device``, from ``seed``."""
    layers = cfg["layers"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = conv_shapes(layers, cfg["input_size"])
    heads = {i - 1 for i, lay in enumerate(layers) if lay["type"] == "detect"}
    residual = {i - 1 for i, lay in enumerate(layers)
                if lay["type"] == "shortcut"}
    sizes = [cout * cin * k * k for _, cin, cout, k, _, _ in shapes]
    w_all = torch.randn(sum(sizes), generator=gen, device=device)
    bn = [(i, cout) for i, _, cout, _, _, _ in shapes
          if layers[i]["bn"]]
    plain = [(i, cout) for i, _, cout, _, _, _ in shapes
             if not layers[i]["bn"]]
    n_bn = sum(c for _, c in bn)
    n_plain = sum(c for _, c in plain)
    uni = torch.rand(2 * n_bn, generator=gen, device=device)
    nrm = torch.randn(2 * n_bn + n_plain, generator=gen, device=device)
    params = {}
    off = 0
    for (i, cin, cout, k, _, _), n in zip(shapes, sizes):
        gain = 0.5 if i in heads else 2.0
        w = w_all[off:off + n].view(cout, cin, k, k)
        params[i] = {"w": w * (gain / (cin * k * k)) ** 0.5}
        off += n
    off = 0
    for i, cout in bn:
        g = 0.15 if i in residual else 1.0
        u_g = uni[off:off + cout]
        u_v = uni[n_bn + off:n_bn + off + cout]
        params[i].update(gamma=(0.8 + 0.4 * u_g) * g,
                         beta=0.1 * nrm[off:off + cout],
                         mean=0.1 * nrm[n_bn + off:n_bn + off + cout],
                         var=0.8 + 0.4 * u_v)
        off += cout
    off = 2 * n_bn
    for i, cout in plain:
        params[i]["b"] = 0.1 * nrm[off:off + cout]
        off += cout
    return params

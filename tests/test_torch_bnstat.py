"""TPU kernel row 5, pallas_conv3x3_bnstat (tools/probe_conv_bnstat.py:47),
against the port's ops/kernels/conv_bnstat on the CPU, where the wrapper
runs its plain version; the CUDA kernel itself is held to that plain
version on the card by chip_smoke.py (phase 8).

- bf16, against the Pallas probe interpreted on the CPU: y within 1 bf16
  ulp (both round one f32 accumulator, summed in another order); the sums
  within rtol 1e-5 / atol 1e-4 (the probe adds f32 partials per M tile,
  the plain version sums in float64).
- f32, against lax.conv at Precision.HIGHEST and jnp.sum of the
  accumulator and its square: y rtol 1e-5 / atol 1e-5, sums rtol 1e-5 /
  atol 1e-4.
- The autograd backward against finite differences in float64
  (torch.autograd.gradcheck), and the bf16 backward against JAX's VJP of
  its mixed-precision conv + onepass statistics within 2**-7 of each
  gradient's largest value (2 bf16 ulps at that scale: JAX rounds each
  cotangent term to bf16 before adding them, the port adds them in f32 and
  rounds once; measured 2.3e-3 for dx, 3.1e-3 for dw).
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from yolo_tensorflow_tpu.ops import layers as JL
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS

from torch_parity import model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_TOL = dict(rtol=1e-5, atol=1e-4)


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "probe_conv_bnstat", os.path.join(REPO, "tools",
                                          "probe_conv_bnstat.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port(x_nhwc, w_hwio, dtype):
    """NHWC / HWIO numpy -> channels-last NCHW / OIHW tensors of dtype."""
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    return (x.to(dtype).contiguous(memory_format=torch.channels_last),
            w.to(dtype).contiguous(memory_format=torch.channels_last))


def _bf16_ulps(a, b):
    """Largest distance between two bfloat16 tensors in bf16 ulps."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).long()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (1, 6, 10, 8, 32)])
def test_plain_matches_pallas_probe(shape, rng, monkeypatch):
    """The probe in Pallas' TPU interpreter (plain interpret=True cannot run
    its program_id inside run_scoped)."""
    b, h, w, cin, cout = shape
    probe = _probe_module()
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    x = jnp.asarray(rng.normal(0, 1, (b, h, w, cin)), jnp.bfloat16)
    wt = jnp.asarray(rng.normal(0, 0.1, (3, 3, cin, cout)), jnp.bfloat16)
    want_y, want_s, want_q = probe.pallas_conv3x3_bnstat(x, wt, tm=64,
                                                         co_tile=32)
    xt, wtt = _port(np.asarray(x.astype(jnp.float32)),
                    np.asarray(wt.astype(jnp.float32)), torch.bfloat16)
    before = BS.launches
    y, s, q = BS.conv3x3_bnstat_forward(xt, wtt)
    assert BS.launches == before
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    assert y.is_contiguous(memory_format=torch.channels_last)
    want = torch.from_numpy(np.asarray(want_y.astype(jnp.float32))).to(
        torch.bfloat16)
    assert _bf16_ulps(y.permute(0, 2, 3, 1), want) <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SUM_TOL)
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), **SUM_TOL)


@pytest.mark.parametrize("cin,cout", [(3, 8), (16, 24), (32, 64)])
def test_f32_plain_matches_lax_conv(cin, cout, rng):
    x = rng.normal(0.2, 1, (2, 7, 9, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, (3, 3, cin, cout)).astype(np.float32)
    acc = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST)
    y, s, q = BS.conv3x3_bnstat_forward(*_port(x, w, torch.float32))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(acc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(jnp.sum(
        acc, axis=(0, 1, 2))), **SUM_TOL)
    np.testing.assert_allclose(q.numpy(), np.asarray(jnp.sum(
        acc * acc, axis=(0, 1, 2))), **SUM_TOL)


@pytest.mark.parametrize("cin,cout", [(3, 4), (5, 3)])
def test_backward_matches_finite_differences(cin, cout, rng):
    x, w = _port(rng.normal(0, 1, (2, 4, 5, cin)),
                 rng.normal(0, 0.5, (3, 3, cin, cout)), torch.float64)
    x.requires_grad_()
    w.requires_grad_()
    assert torch.autograd.gradcheck(BS.conv3x3_bnstat, (x, w))


def test_bf16_backward_matches_jax_vjp(rng):
    """Cotangents on y, the mean and the onepass E[y^2] of a bf16 conv:
    JAX differentiates its bf16 output through astype(f32) reductions; the
    port folds the f32 statistic cotangents into one bf16 cotangent."""
    x = rng.normal(0, 1, (2, 6, 6, 16)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    gy = rng.normal(0, 1, (2, 6, 6, 8)).astype(np.float32)
    gm, gq = rng.normal(0, 50, 8), rng.normal(0, 50, 8)
    n = 2 * 6 * 6

    def jf(xh, wh):
        y = JL.conv2d(xh, wh, None, compute_dtype=jnp.bfloat16, train=True,
                      out_dtype=jnp.bfloat16)
        y32 = y.astype(jnp.float32)
        return (jnp.sum(y32 * gy) + jnp.sum(jnp.mean(y32, (0, 1, 2)) * gm)
                + jnp.sum(jnp.mean(y32 * y32, (0, 1, 2)) * gq))

    jx, jw = jax.grad(jf, (0, 1))(jnp.asarray(x).astype(jnp.bfloat16),
                                  jnp.asarray(w).astype(jnp.bfloat16))
    xt, wt = _port(x, w, torch.bfloat16)
    xt.requires_grad_()
    wt.requires_grad_()
    y, s, q = BS.conv3x3_bnstat(xt, wt)
    loss = ((y.float() * torch.from_numpy(gy).permute(0, 3, 1, 2)).sum()
            + (s / n * torch.from_numpy(gm).float()).sum()
            + (q / n * torch.from_numpy(gq).float()).sum())
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    for got, want in ((dx.permute(0, 2, 3, 1), jx), (dw.permute(2, 3, 1, 0),
                                                     jw)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2 ** -7 * np.abs(want).max(), err


@pytest.mark.parametrize("bad,err", [
    (lambda x, w: (x.contiguous(), w), ValueError),
    (lambda x, w: (x, w.contiguous()), ValueError),
    (lambda x, w: (x.half(), w.half()), TypeError),
    (lambda x, w: (x, w.to(torch.bfloat16)), TypeError),
    (lambda x, w: (x, w[:, :2]), ValueError),
    (lambda x, w: (x, w[..., :2, :2]), ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err, rng):
    x, w = _port(rng.normal(0, 1, (1, 4, 4, 8)).astype(np.float32),
                 rng.normal(0, 1, (3, 3, 8, 4)).astype(np.float32),
                 torch.float32)
    with pytest.raises(err):
        BS.conv3x3_bnstat_forward(*bad(x, w))


@pytest.mark.parametrize("name,n", [("yolov3", 33), ("yolov3-tiny", 9),
                                    ("narrow", 4)])
def test_train_forward_routes_every_3x3_s1_bn_conv(name, n, monkeypatch):
    """Every 3x3 stride-1 BN conv, and no other, goes through conv_bnstat:
    33 of yolov3's 75 convs (the 1x1, stride-2 and bias-only head convs go
    to cuDNN), 9 of yolov3-tiny's 13."""
    cfg, specs = model(name, 32 if name == "yolov3" else 64)
    want = sum(TE.uses_conv_bnstat(sp) for sp in specs)
    assert want == n
    calls = []
    real = BS.conv3x3_bnstat

    def counting(x, w):
        calls.append(tuple(w.shape))
        return real(x, w)

    monkeypatch.setattr(BS, "conv3x3_bnstat", counting)
    params, _ = TE.init_params(specs, cfg.input_size, 0)
    net = TE.TrainNetwork(specs, params)
    x = torch.zeros((1, 3, cfg.input_size, cfg.input_size)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        dets, stats = net(x, bn_stats="onepass")
    assert len(calls) == want
    assert len(stats) == sum(1 for sp in specs if getattr(sp, "bn", False)
                             and type(sp).__name__ == "Conv")
    assert all(f.dtype == torch.float32 for f, _ in dets)

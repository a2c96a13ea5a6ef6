"""yolo_tensorflow_tpu_torch/tools/int8_ablate.py against tools/int8_ablate.py
on the CPU, at the narrow specs of tests/torch_parity.py (64^2, B=2).

The reference side is the tool's own code: its nested ``apply_with``, the
five ``conv_*`` formulations and the chained loop's ``body`` are found with
``ast`` in its source and executed in a namespace of the JAX package's
modules, so nothing of it is copied here. Both sides take the same numpy
folded weights, every conv's input scale 0.05 and ``quantize_params``
(heads float). The JAX walk runs op by op, each operation rounding as
written: jitted whole, XLA's CPU compiler keeps the normalized input in
float32 where the source rounds it to bf16 before the first quantize
(excess precision), which moves 23 % of the first conv's outputs. Every
quantized conv's output in the walk is recorded on both sides and held,
and so are the heads the walk returns:

- ``int8-SOL-no-epilogue``: every conv output equal (int8 integers);
- ``int8-v0-f32-epilogue``, ``int8-v1-bf16-epilogue``: every conv output
  bit for bit, and the heads of v0 equal to v1's on each side (both round
  the epilogue in bf16 with bf16(0.1); v0's leaky is a pass of its own);
- ``int8-v2-folded``: every conv output bit for bit (b / s one IEEE
  division on both sides, the float32 0.1, one rounding of y * s);
- ``bf16-ref``'s conv outputs, and every row's heads (float convs, of int8
  input under SOL), within BF16_TOL of each tensor's largest magnitude
  (measured: 0.017 and 0.016 at most): the port's bf16 conv, cuDNN's on
  the card, rounds its output to bf16 before the float32 bias, JAX's keeps
  the float32 conv result.
On the CPU the two probe copies run their plain versions (``folded_plain``,
``sol_plain``). One chained iteration's uint8 input update, with
wraparound at 255 and a negative sum, equals the reference's ``body``.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from yolo_tensorflow_tpu.models import engine as JE
from yolo_tensorflow_tpu.models import specs as JS
from yolo_tensorflow_tpu.ops import layers as JL
from yolo_tensorflow_tpu.ops import quant as JQ
from yolo_tensorflow_tpu.pipeline import normalize_images as j_normalize
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.models import specs as TS
from yolo_tensorflow_tpu_torch.ops import quant as TQ
from yolo_tensorflow_tpu_torch.tools import int8_ablate as IA

from torch_parity import folded_params, images, jax_model, model

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "int8_ablate.py"
# reference name -> its function in the tool's main()
REFERENCE = {"bf16-ref": "conv_sol_bf16", "int8-v0-f32-epilogue": "conv_v0",
             "int8-v1-bf16-epilogue": "conv_v1", "int8-v2-folded": "conv_v2",
             "int8-SOL-no-epilogue": "conv_sol"}
SIZE, BATCH = 64, 2
BF16_TOL = 3e-2         # max |err| over each tensor's largest |value|
SPECS = ("narrow-leaky", "narrow")


def _reference(names, **env):
    """The tool's nested functions ``names``, executed from its source in a
    namespace holding ``env``."""
    tree = ast.parse(SOURCE.read_text())
    found = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name in names}
    ns = dict(env)
    exec(compile(ast.Module(body=[found[n] for n in names], type_ignores=[]),
                 str(SOURCE), "exec"), ns)
    return ns


def _scales(specs):
    return {TE.layer_key(i): IA.ACT_SCALE for i, sp in enumerate(specs)
            if isinstance(sp, TS.Conv)}


@pytest.fixture(scope="module", params=SPECS)
def walks(request):
    """{row: ((port conv outputs, port heads), (JAX's))} of one spec."""
    name = request.param
    cfg, specs = model(name, SIZE)
    jcfg, jspecs = jax_model(name, SIZE)
    port, jax_params = folded_params(specs, SIZE)
    scales = _scales(specs)
    qp = IA.prepare(specs, TQ.quantize_params(specs, port, scales), "cpu")
    jq = JQ.quantize_params(jspecs, jax_params, scales)
    ns = _reference(["apply_with", *REFERENCE.values()], jnp=jnp, lax=lax,
                    Q=JQ, L=JL, S=JS, engine=JE,
                    normalize_images=j_normalize, cfg=jcfg, specs=jspecs)
    imgs = images(BATCH, SIZE, seed=7)
    out = {}
    for row, ref in REFERENCE.items():
        def jrun(pp, im, ref=ref):
            rec = []

            def conv(x, p, spec, pad):
                rec.append(ns[ref](x, p, spec, pad))
                return rec[-1]
            return ns["apply_with"](conv, pp)(pp, im), rec
        jheads, jconvs = jrun(jax.device_put(jq), jnp.asarray(imgs))

        tconvs, real = [], IA.CONVS[row]

        def record(x, p, spec, pad):
            tconvs.append(real(x, p, spec, pad))
            return tconvs[-1]
        IA.CONVS[row] = record
        try:
            with torch.inference_mode():
                theads = IA.walk(cfg, specs, qp, row)(torch.from_numpy(imgs))
        finally:
            IA.CONVS[row] = real
        out[row] = ((tconvs, theads), (jconvs, jheads))
    return out


def _np(t):
    """A port tensor (NCHW) as the JAX package's NHWC float32 array."""
    return t.permute(0, 2, 3, 1).to(torch.float32).numpy()


def _pairs(walks, row):
    (tconvs, theads), (jconvs, jheads) = walks[row]
    assert len(tconvs) == len(jconvs) > 0 and len(theads) == len(jheads)
    return ([(_np(t), np.asarray(j, np.float32)) for t, j in
             zip(tconvs, jconvs)],
            [(_np(t), np.asarray(j, np.float32)) for t, j in
             zip(theads, jheads)])


def _close(got, want, what):
    """got within BF16_TOL of want's largest magnitude."""
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= BF16_TOL, f"{what}: max |err| {err:.3g} of the largest"


def test_sol_is_exact(walks):
    convs, _ = _pairs(walks, "int8-SOL-no-epilogue")
    for k, (got, want) in enumerate(convs):
        np.testing.assert_array_equal(got, want, err_msg=f"conv {k}")
    (tconvs, _), (jconvs, _) = walks["int8-SOL-no-epilogue"]
    assert all(t.dtype == torch.int8 for t in tconvs)
    assert all(j.dtype == jnp.int8 for j in jconvs)


@pytest.mark.parametrize("row", ["int8-v0-f32-epilogue",
                                 "int8-v1-bf16-epilogue", "int8-v2-folded"])
def test_epilogue_rows_bit_for_bit(walks, row):
    convs, _ = _pairs(walks, row)
    for k, (got, want) in enumerate(convs):
        np.testing.assert_array_equal(got, want, err_msg=f"{row} conv {k}")


@pytest.mark.parametrize("row", list(REFERENCE))
def test_heads_within_tolerance(walks, row):
    _, heads = _pairs(walks, row)
    for k, (got, want) in enumerate(heads):
        _close(got, want, f"{row} head {k}")


def test_v0_equals_v1_on_both_sides(walks):
    (_, t0), (_, j0) = walks["int8-v0-f32-epilogue"]
    (_, t1), (_, j1) = walks["int8-v1-bf16-epilogue"]
    assert all(torch.equal(a, b) for a, b in zip(t0, t1))
    assert all(np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))
               for a, b in zip(j0, j1))


def test_bf16_ref_within_tolerance(walks):
    convs, _ = _pairs(walks, "bf16-ref")
    for k, (got, want) in enumerate(convs):
        _close(got, want, f"bf16-ref conv {k}")


def test_folded_plain_is_the_reference_formula():
    """``folded_plain`` at one conv equals the reference's conv_v2 (eager
    JAX) bit for bit: the quantize, f32(acc) + b/s with b/s divided once,
    leaky with float32 0.1, one rounding of y * s to bf16."""
    ns = _reference(["conv_v2"], jnp=jnp, lax=lax)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 9, 9, 16)).astype(np.float32)
    w_q = rng.integers(-127, 128, (3, 3, 16, 24)).astype(np.int8)
    s_x, s_w = np.float32(0.05), rng.uniform(0.002, 0.01, 24).astype(
        np.float32)
    b = rng.normal(0, 1, 24).astype(np.float32)
    spec = JS.Conv(24, 3)
    want = ns["conv_v2"](jnp.asarray(x, jnp.bfloat16),
                         {"w_q": w_q, "s_x": s_x, "s_w": s_w, "b": b},
                         spec, 1)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w_q).permute(3, 2, 0, 1)
    s_wt, bt = torch.from_numpy(s_w), torch.from_numpy(b)
    b_over_s = bt / (torch.tensor(0.05, dtype=torch.float32) * s_wt)
    got = IA.folded_plain(xt.contiguous(memory_format=torch.channels_last),
                          wt.contiguous(memory_format=torch.channels_last),
                          float(s_x), s_wt, b_over_s, act="leaky")
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("name", SPECS)
def test_copy_cases_cover_the_walk(name):
    """``copy_cases`` takes exactly one conv for each (copy, instance, BN,
    kernel size, stride, activation) of the walk's quantized convs, and
    ``check_copies`` holds each of them (plain against plain here)."""
    from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as Q8
    _, specs = model(name, SIZE)
    port, _ = folded_params(specs, SIZE)
    qp = IA.prepare(specs, TQ.quantize_params(specs, port, _scales(specs)),
                    "cpu")
    cases = IA.copy_cases(specs, qp, SIZE)
    taken = [(c, *plan, specs[i].size, specs[i].stride, IA._leaky(specs[i]))
             for c, i, _, _, plan in cases]
    assert len(taken) == len(set(taken))
    walked = set()
    for i, sp in enumerate(specs):
        p = qp.get(TE.layer_key(i), {})
        if isinstance(sp, TS.Conv) and "w_q" in p:
            xq = torch.empty(16, dtype=torch.int8)
            for c, plan in (("folded", Q8.plan(xq, p["w_q"], sp.stride,
                                               torch.bfloat16)),
                            ("sol", Q8.plan_q(xq, p["w_q"], True,
                                              sp.stride))):
                walked.add((c, *plan, sp.size, sp.stride, IA._leaky(sp)))
    assert set(taken) == walked
    checked = IA.check_copies(specs, qp, SIZE, "cpu", batch=1)
    assert len(checked) == len(cases)
    assert all(d == 0.0 for *_, d in checked.values())


def test_walk_refuses_a_layer_it_does_not_walk():
    with pytest.raises(NotImplementedError, match="Reorg"):
        IA.walk(None, [TS.Conv(8, 3), TS.Reorg()], {},
                "int8-v1-bf16-epilogue")


@pytest.mark.parametrize("sums,pixel", [((3.0, 0.25), 255), ((-5.5, 0.0), 7),
                                        ((4.0, 0.75), 255)])
def test_chained_input_update(sums, pixel):
    """One iteration of the chained loop: the images shifted by int(sum)
    % 2 with uint8 wraparound, the accumulator plus the sum, as the
    reference's ``body``."""
    im = np.full((1, 2, 2, 3), pixel, np.uint8)
    im[0, 0, 0, 0] = 0
    outs = [np.full((1, 2, 1, 1), sums[0] / 2, np.float32),
            np.full((1, 1, 1, 1), sums[1], np.float32)]
    ns = _reference(["body"], jnp=jnp, pp=None,
                    fwd=lambda pp, im: [jnp.asarray(outs[0]),
                                        jnp.asarray(outs[1], jnp.bfloat16)])
    j_im, j_acc = ns["body"](0, (jnp.asarray(im), jnp.float32(1.5)))
    t_im, t_acc = IA.chain_step(
        lambda images: [torch.from_numpy(outs[0]),
                        torch.from_numpy(outs[1]).to(torch.bfloat16)],
        torch.from_numpy(im), torch.tensor(1.5))
    assert t_im.dtype == torch.uint8
    np.testing.assert_array_equal(t_im.numpy(), np.asarray(j_im))
    assert float(t_acc) == float(j_acc)

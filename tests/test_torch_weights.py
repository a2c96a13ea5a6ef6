"""Port .weights reader/writer (yolo_tensorflow_tpu_torch/io/weights.py) vs
the JAX package's io/weights.py: the files are byte-identical and the folded
parameters equal exactly (same float32 operations on the same values), for
convolutional and connected layers."""

import numpy as np
import pytest

from yolo_tensorflow_tpu.io import weights as JW
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import engine as TE

from torch_parity import jax_model, model, to_jax, write_weights

SIZE = 64


@pytest.fixture(params=["narrow", "yolov3-tiny", "narrow-v2", "narrow-v1"])
def written(request, tmp_path):
    """(port specs, JAX specs, port-written path, unfolded port params,
    stats)."""
    _, specs = model(request.param, SIZE)
    _, jspecs = jax_model(request.param, SIZE)
    path = tmp_path / "m.weights"
    params, stats = write_weights(specs, SIZE, path)
    return specs, jspecs, path, params, stats


def test_writer_byte_identical(written, tmp_path):
    _, jspecs, path, params, stats = written
    jax_path = tmp_path / "jax.weights"
    JW.save_darknet_weights(jspecs, SIZE, to_jax(params), stats, jax_path)
    assert path.read_bytes() == jax_path.read_bytes()


def test_reader_equals_jax_exactly(written):
    specs, jspecs, path, _, _ = written
    want, _, want_header = JW.load_darknet_weights(jspecs, SIZE, str(path))
    got, header = TW.load_darknet_weights(specs, SIZE, str(path))
    assert header == want_header
    assert got.keys() == want.keys()
    for key, p in TW.params_from_jax(want).items():
        for name in ("w", "b"):
            np.testing.assert_array_equal(got[key][name], p[name])


def test_params_from_jax_round_trips(written):
    specs, _, path, _, _ = written
    got, _ = TW.load_darknet_weights(specs, SIZE, path.read_bytes())
    back = TW.params_from_jax(to_jax(got))
    for key, p in got.items():
        np.testing.assert_array_equal(back[key]["w"], p["w"])
        assert back[key]["w"].flags.c_contiguous


def test_truncated_file_raises(written):
    specs, _, path, _, _ = written
    data = path.read_bytes()
    with pytest.raises(TW.WeightsFormatError, match="exhausted"):
        TW.load_darknet_weights(specs, SIZE, data[:-4])
    with pytest.raises(TW.WeightsFormatError, match="truncated header"):
        TW.load_darknet_weights(specs, SIZE, data[:8])


def test_overlong_file_raises(written):
    specs, _, path, _, _ = written
    with pytest.raises(TW.WeightsFormatError, match="3 unconsumed floats"):
        TW.load_darknet_weights(specs, SIZE,
                                path.read_bytes() + bytes(12))


@pytest.mark.parametrize("major,minor", [(0, 1), (0, 2), (1, 0)])
def test_header_version_rule_matches_jax(major, minor):
    """seen is int32 before version 0.2 and int64 from then on."""
    import io
    buf = io.BytesIO()
    TW.write_header(buf, major=major, minor=minor, revision=5, seen=1234)
    assert len(buf.getvalue()) == (16 if (major, minor) < (0, 2) else 20)
    buf.seek(0)
    got = TW.read_header(buf)
    buf.seek(0)
    assert got == JW.read_header(buf)
    assert got == {"major": major, "minor": minor, "revision": 5,
                   "seen": 1234}


def test_unported_weights_raise():
    from yolo_tensorflow_tpu_torch.models import specs as S
    specs = (S.Conv(4, 3), S.Local(4, 3))          # the long tail
    with pytest.raises(NotImplementedError):
        TW.load_darknet_weights(specs, 16, bytes(20))
    with pytest.raises(NotImplementedError):
        TW.save_darknet_weights(specs, 16, {}, {}, "unused.weights")


def test_connected_weights_are_in_out_in_both_packages(tmp_path):
    """darknet stores connected weights (Out, In); both packages hold (In,
    Out). params_from_jax leaves a 2-D w as it is, and the reader
    transposes the file's rows."""
    _, specs = model("narrow-v1", SIZE)
    _, jspecs = jax_model("narrow-v1", SIZE)
    path = tmp_path / "v1.weights"
    params, _ = write_weights(specs, SIZE, path)
    assert params["L006"]["w"].shape == (128, 32)          # (In, Out)
    got, _ = TW.load_darknet_weights(specs, SIZE, str(path))
    want, _, _ = JW.load_darknet_weights(jspecs, SIZE, str(path))
    for key in ("L006", "L007", "L009"):
        assert got[key]["w"].shape == np.asarray(want[key]["w"]).shape
        np.testing.assert_array_equal(got[key]["w"], params[key]["w"])
        np.testing.assert_array_equal(got[key]["w"], want[key]["w"])
    carried = TW.params_from_jax(want)
    np.testing.assert_array_equal(carried["L006"]["w"], want["L006"]["w"])
    assert carried["L000"]["w"].shape == (8, 3, 7, 7)       # conv: OIHW
    with pytest.raises(NotImplementedError, match="long tail"):
        TW.params_from_jax({"L000": {"w": np.zeros((2, 3, 4))}})


def test_connected_bn_folds_as_jax(tmp_path):
    """A connected layer with batch norm: biases are the BN's beta, the
    scales, mean and variance follow the weights, and the fold is darknet's
    formula, as in the JAX package's reader."""
    from yolo_tensorflow_tpu.models import specs as JS
    from yolo_tensorflow_tpu_torch.models import specs as S
    mk = lambda M: (M.Conv(4, 3, stride=2), M.TransposeFlatten(),
                    M.Dense(6, bn=True), M.Dense(3, act="linear"))
    rng = np.random.default_rng(5)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    pos = lambda n: rng.uniform(0.5, 1.5, n).astype(np.float32)
    params = {"L000": {"w": f(4, 3, 3, 3), "gamma": pos(4), "beta": f(4)},
              "L002": {"w": f(64, 6), "gamma": pos(6), "beta": f(6)},
              "L003": {"w": f(6, 3), "b": f(3)}}
    stats = {"L000": {"mean": f(4), "var": pos(4)},
             "L002": {"mean": f(6), "var": pos(6)}}
    path, jpath = tmp_path / "fc.weights", tmp_path / "jfc.weights"
    TW.save_darknet_weights(mk(S), 8, params, stats, path)
    JW.save_darknet_weights(mk(JS), 8, to_jax(params), stats, jpath)
    assert path.read_bytes() == jpath.read_bytes()
    got, _ = TW.load_darknet_weights(mk(S), 8, str(path))
    want, _, _ = JW.load_darknet_weights(mk(JS), 8, str(path))
    for key in ("L002", "L003"):
        for name in ("w", "b"):
            np.testing.assert_array_equal(got[key][name], want[key][name])


def test_init_params_seeded():
    _, specs = model("narrow", SIZE)
    a, sa = TE.init_params(specs, SIZE, 3)
    b, sb = TE.init_params(specs, SIZE, 3)
    for key in a:
        np.testing.assert_array_equal(a[key]["w"], b[key]["w"])
    assert sa.keys() == sb.keys()

"""Port .weights reader/writer (yolo_tensorflow_tpu_torch/io/weights.py) vs
the JAX package's io/weights.py: the files are byte-identical and the folded
parameters equal exactly (same float32 operations on the same values)."""

import numpy as np
import pytest

from yolo_tensorflow_tpu.io import weights as JW
from yolo_tensorflow_tpu_torch.io import weights as TW
from yolo_tensorflow_tpu_torch.models import engine as TE

from torch_parity import jax_model, model, to_jax, write_weights

SIZE = 64


@pytest.fixture(params=["narrow", "yolov3-tiny"])
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
    _, specs = model("yolov2", 416)        # holds a Reorg
    with pytest.raises(NotImplementedError):
        TW.load_darknet_weights(specs, 416, bytes(20))


def test_init_params_seeded():
    _, specs = model("narrow", SIZE)
    a, sa = TE.init_params(specs, SIZE, 3)
    b, sb = TE.init_params(specs, SIZE, 3)
    for key in a:
        np.testing.assert_array_equal(a[key]["w"], b[key]["w"])
    assert sa.keys() == sb.keys()

"""Darknet ``.cfg`` emitter: layer specs -> the INI format src/parser.c:730
consumes.

Interop counterpart to the .weights writer: together they export any model
in this framework to a fully darknet-loadable (cfg, weights) pair — and they
power the C-oracle parity harness (tests load the emitted pair into the
*reference's own* compiled darknet and diff raw activations against ours).

Index mapping: every spec maps 1:1 to a darknet section except
TransposeFlatten (implicit in darknet — its connected layer already consumes
CHW-flattened input, which is exactly why the spec exists on our NHWC side).
Detect markers become [yolo]/[region]/[detection] sections (they ARE layers
in darknet).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from yolo_tensorflow_tpu_torch import config as C
from yolo_tensorflow_tpu_torch.models import specs as S


def specs_to_cfg(cfg: C.ModelConfig, specs=None, *, batch: int = 1,
                 inputs: Optional[int] = None, time_steps: int = 1,
                 max_batches: Optional[int] = None) -> str:
    """Emit a darknet .cfg for ``specs``. ``inputs`` switches the [net]
    section to flat-input form (darknet's ``inputs=``, parse_net_options)
    for recurrent/connected-first nets; ``time_steps`` emits the net-level
    recurrent step count (src/parser.c:650).

    ``max_batches`` scales the canonical steps-policy schedule to a run
    of that length: LR drops x0.1 at 80% and 90% of it, the proportions
    of the stock yolov3 cfg (500200: 400000,450000). Without it the
    emitted boundaries are the stock ones — which a short run never
    reaches, leaving the whole run at constant learning_rate (the
    flagship run measured a 0.91 -> 0.74 held-out mAP oscillation from
    exactly that; see tools/flagship_train.py)."""
    specs = C.build_specs(cfg) if specs is None else specs
    out: List[str] = []
    out.append("[net]")
    out.append(f"batch={batch}")
    out.append("subdivisions=1")
    if inputs is not None:
        out.append(f"inputs={inputs}")
    else:
        out.append(f"height={cfg.input_size}")
        out.append(f"width={cfg.input_size}")
        out.append("channels=3")
    if time_steps != 1:
        out.append(f"time_steps={time_steps}")
    out.append("momentum=0.9\ndecay=0.0005")
    mb = 500200 if max_batches is None else int(max_batches)
    s1, s2 = (400000, 450000) if max_batches is None else (
        int(mb * 0.8), int(mb * 0.9))
    out.append(f"learning_rate=0.001\nburn_in=1000\nmax_batches={mb}")
    out.append(f"policy=steps\nsteps={s1},{s2}\nscales=.1,.1")
    out.append("")

    # spec index -> darknet layer index (TransposeFlatten emits no section)
    dk_index: List[Optional[int]] = []
    n_emitted = 0

    def ref_to_dk(ref, i):
        r = S.resolve_ref(ref, i)
        if r == S.INPUT:
            raise ValueError("cfg cannot route to the input")
        d = dk_index[r]
        if d is None:  # points at a TransposeFlatten; use its predecessor
            d = dk_index[r - 1]
        return d

    anchors_flat = ",".join(
        f"{a[0]:g},{a[1]:g}" for a in cfg.anchors) if cfg.anchors else ""

    for i, spec in enumerate(specs):
        emitted = True
        if isinstance(spec, S.Conv):
            out.append("[convolutional]")
            if spec.bn:
                out.append("batch_normalize=1")
            out.append(f"filters={spec.filters}")
            out.append(f"size={spec.size}")
            out.append(f"stride={spec.stride}")
            if spec.pad < 0 or spec.pad == spec.size // 2:
                out.append("pad=1")
            else:
                out.append(f"padding={spec.pad}")
            out.append(f"activation={spec.act if spec.act != 'linear' else 'linear'}")
        elif isinstance(spec, S.MaxPool):
            out.append("[maxpool]")
            out.append(f"size={spec.size}")
            out.append(f"stride={spec.stride}")
        elif isinstance(spec, S.Route):
            out.append("[route]")
            cur_dk = n_emitted  # index this section will get
            rels = [ref_to_dk(r, i) - cur_dk for r in spec.refs]
            out.append("layers=" + ",".join(str(r) for r in rels))
        elif isinstance(spec, S.Shortcut):
            out.append("[shortcut]")
            out.append(f"from={ref_to_dk(spec.ref, i) - n_emitted}")
            out.append("activation=linear")
        elif isinstance(spec, S.Reorg):
            if spec.mode != "darknet":
                raise ValueError(
                    "cfg cannot represent Reorg(mode='space_to_depth') — "
                    "darknet's [reorg] has different channel order")
            out.append("[reorg]")
            out.append(f"stride={spec.stride}")
        elif isinstance(spec, S.Upsample):
            out.append("[upsample]")
            out.append(f"stride={spec.factor}")
        elif isinstance(spec, S.Dense):
            out.append("[connected]")
            if spec.bn:
                out.append("batch_normalize=1")
            out.append(f"output={spec.units}")
            out.append(f"activation={spec.act}")
        elif isinstance(spec, S.Rnn):
            out.append("[rnn]")
            if spec.bn:
                out.append("batch_normalize=1")
            out.append(f"output={spec.output}")
            out.append(f"activation={spec.act}")
            if spec.shortcut:
                out.append("shortcut=1")
        elif isinstance(spec, S.Gru):
            out.append("[gru]")
            if spec.bn:
                out.append("batch_normalize=1")
            out.append(f"output={spec.output}")
            if spec.tanh:
                out.append("tanh=1")
        elif isinstance(spec, S.Lstm):
            out.append("[lstm]")
            if spec.bn:
                out.append("batch_normalize=1")
            out.append(f"output={spec.output}")
        elif isinstance(spec, S.Crnn):
            out.append("[crnn]")
            if spec.bn:
                out.append("batch_normalize=1")
            out.append(f"output_filters={spec.output_filters}")
            out.append(f"hidden_filters={spec.hidden_filters}")
            out.append(f"activation={spec.act}")
            if spec.shortcut:
                out.append("shortcut=1")
        elif isinstance(spec, S.Dropout):
            out.append("[dropout]")
            out.append(f"probability={spec.rate}")
        elif isinstance(spec, S.Local):
            out.append("[local]")
            out.append(f"filters={spec.filters}")
            out.append(f"size={spec.size}")
            out.append(f"stride={spec.stride}")
            out.append(f"pad={spec.pad}")
            out.append(f"activation={spec.act}")
        elif isinstance(spec, S.Deconv):
            out.append("[deconvolutional]")
            if spec.bn:
                out.append("batch_normalize=1")
            out.append(f"filters={spec.filters}")
            out.append(f"size={spec.size}")
            out.append(f"stride={spec.stride}")
            out.append(f"padding={spec.pad}")
            out.append(f"activation={spec.act}")
        elif isinstance(spec, S.Crop):
            out.append("[crop]")
            out.append(f"crop_height={spec.crop_height}")
            out.append(f"crop_width={spec.crop_width}")
            out.append(f"flip={int(spec.flip)}")
            out.append(f"noadjust={int(spec.noadjust)}")
        elif isinstance(spec, S.LRN):
            out.append("[normalization]")
            out.append(f"size={spec.size}")
            out.append(f"alpha={spec.alpha:g}")
            out.append(f"beta={spec.beta:g}")
            out.append(f"kappa={spec.kappa:g}")
        elif isinstance(spec, S.L2Norm):
            out.append("[l2norm]")
        elif isinstance(spec, S.Logistic):
            out.append("[logistic]")
        elif isinstance(spec, S.GlobalAvgPool):
            out.append("[avgpool]")
        elif isinstance(spec, S.Softmax):
            out.append("[softmax]")
            out.append(f"groups={spec.groups}")
            if spec.temperature != 1.0:
                out.append(f"temperature={spec.temperature:g}")
        elif isinstance(spec, S.Detect):
            if cfg.head == 3:
                out.append("[yolo]")
                out.append("mask=" + ",".join(str(m) for m in spec.anchor_mask))
                out.append(f"anchors={anchors_flat}")
                out.append(f"classes={cfg.num_classes}")
                out.append(f"num={cfg.num_anchors}")
                out.append("jitter=.3\nignore_thresh=.5\ntruth_thresh=1\nrandom=0")
            elif cfg.head == 2:
                out.append("[region]")
                if getattr(cfg, "tree_file", ""):
                    out.append(f"tree={cfg.tree_file}")
                out.append(f"anchors={anchors_flat}")
                out.append(f"bias_match=1\nclasses={cfg.num_classes}")
                out.append(f"coords=4\nnum={cfg.num_anchors}")
                out.append("softmax=1\njitter=.3\nrescore=1")
                out.append("object_scale=5\nnoobject_scale=1\nclass_scale=1"
                           "\ncoord_scale=1\nabsolute=1\nthresh=.6\nrandom=0")
            elif cfg.head == 0:
                emitted = False  # classifier: softmax is already the output
            else:
                out.append("[detection]")
                out.append(f"classes={cfg.num_classes}")
                out.append(f"coords=4\nrescore=1\nside={cfg.grid}")
                out.append(f"num={cfg.boxes_per_cell}")
                out.append("softmax=0\nsqrt=1\njitter=.2")
                out.append("object_scale=1\nnoobject_scale=.5"
                           "\nclass_scale=1\ncoord_scale=5")
        elif isinstance(spec, S.TransposeFlatten):
            emitted = False
        else:  # pragma: no cover
            raise TypeError(f"cannot emit {spec!r}")
        if emitted:
            dk_index.append(n_emitted)
            n_emitted += 1
            out.append("")
        else:
            dk_index.append(None)
    return "\n".join(out)


# ---------------------------------------------------------------------------
# cfg PARSER: darknet .cfg -> layer specs (+ net options)
# ---------------------------------------------------------------------------

def _parse_sections(text: str) -> List[Tuple[str, Dict[str, str]]]:
    sections: List[Tuple[str, Dict[str, str]]] = []
    cur: Optional[Dict[str, str]] = None
    for raw in text.splitlines():
        line = raw.split("#")[0].split(";")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            cur = {}
            sections.append((line.strip("[]").lower(), cur))
        elif "=" in line and cur is not None:
            k, v = line.split("=", 1)
            cur[k.strip()] = v.strip()
    return sections


# flatness tracking for the implicit-CHW-flatten insertion: these spec
# types PRODUCE flat/2D output...
_MAKES_FLAT = (S.Dense, S.TransposeFlatten, S.Rnn, S.Gru, S.Lstm,
               S.GlobalAvgPool)
# ...and these preserve whatever rank they are given (so a [softmax]
# between [connected] and [rnn] keeps the tensor flat — tracked
# contextually, not by the last spec's type alone)
_KEEPS_RANK = (S.Dropout, S.Softmax, S.Logistic, S.L2Norm)


def _is_flat(specs) -> bool:
    for sp in reversed(specs):
        if isinstance(sp, _MAKES_FLAT):
            return True
        if isinstance(sp, _KEEPS_RANK):
            continue
        return False
    return False  # network input (the engine feeds (B,1,1,C) even for
    # flat-input nets, so the first flat consumer still flattens)


def parse_cfg(text: str):
    """Parse a darknet ``.cfg`` into (specs, net_options, head_options) —
    the src/parser.c:730 parse_network_cfg equivalent. Any cfg built from
    the layer types this framework implements loads; the result plugs
    straight into models/engine.apply and io/weights.load_darknet_weights.

    head_options collects [yolo]/[region]/[detection] sections in order
    (anchors, classes, masks, thresholds) so a ModelConfig can be derived.
    """
    sections = _parse_sections(text)
    if not sections or sections[0][0] not in ("net", "network"):
        raise ValueError("cfg must start with [net]")
    net = sections[0][1]
    b = S.SpecBuilder()
    heads: List[Dict] = []
    dk_to_spec: List[int] = []   # darknet layer index -> our spec index

    def geti(d, k, default):
        return int(d.get(k, default))

    def getf(d, k, default):
        return float(d.get(k, default))

    def remap(ref: int, dk_idx: int) -> int:
        """darknet route/shortcut ref (relative if <0, absolute otherwise,
        in darknet layer indices) -> absolute spec index."""
        tgt = dk_idx + ref if ref < 0 else ref
        if not 0 <= tgt < len(dk_to_spec):
            raise ValueError(f"route/shortcut ref {ref} out of range")
        return dk_to_spec[tgt]

    for name, opt in sections[1:]:
        dk_idx = len(dk_to_spec)
        if name == "convolutional":
            act = opt.get("activation", "logistic")  # darknet default
            if act not in ("leaky", "linear", "logistic", "relu"):
                raise ValueError(
                    f"unsupported conv activation {act!r} (supported: "
                    "leaky, linear, logistic, relu)")
            size = geti(opt, "size", 1)
            # darknet pad semantics (parser.c:133-135): padding=N explicit;
            # pad=1 means size//2; default is NO padding
            if "padding" in opt and "pad" not in opt:
                pad = geti(opt, "padding", 0)
            elif geti(opt, "pad", 0):
                pad = size // 2
            else:
                pad = 0
            idx = b.add(S.Conv(geti(opt, "filters", 1), size,
                               geti(opt, "stride", 1),
                               bn=geti(opt, "batch_normalize", 0) == 1,
                               act=act, pad=pad))
        elif name == "maxpool":
            # darknet defaults (parser.c:473-474): stride=1, size=stride
            stride = geti(opt, "stride", 1)
            size = geti(opt, "size", stride)
            idx = b.maxpool(size, stride)
        elif name == "route":
            refs = tuple(remap(int(x), dk_idx)
                         for x in opt["layers"].split(","))
            idx = b.route(*refs)
        elif name == "shortcut":
            idx = b.shortcut(remap(int(opt["from"]), dk_idx))
        elif name == "reorg":
            idx = b.reorg(geti(opt, "stride", 2))
        elif name == "upsample":
            idx = b.add(S.Upsample(geti(opt, "stride", 2)))
        elif name == "connected":
            # darknet flattens CHW implicitly; our NHWC engine needs the
            # explicit marker before the first connected layer
            if not _is_flat(b._specs):
                b.transpose_flatten()
            # darknet DEFAULTS to logistic when the key is omitted
            # (parse_connected, src/parser.c)
            act = opt.get("activation", "logistic")
            if act not in ("leaky", "linear", "logistic", "relu", "tanh"):
                raise ValueError(
                    f"unsupported connected activation {act!r} (supported: "
                    "leaky, linear, logistic, relu, tanh)")
            idx = b.dense(geti(opt, "output", 1), act=act,
                          bn=geti(opt, "batch_normalize", 0) == 1)
        elif name in ("rnn", "gru", "lstm"):
            # recurrent layers consume flat CHW rows like [connected]
            if not _is_flat(b._specs):
                b.transpose_flatten()
            output = geti(opt, "output", 1)
            bn = geti(opt, "batch_normalize", 0) == 1
            if name == "rnn":
                idx = b.add(S.Rnn(output,
                                  act=opt.get("activation", "logistic"),
                                  bn=bn,
                                  shortcut=geti(opt, "shortcut", 0) == 1))
            elif name == "gru":
                idx = b.add(S.Gru(output, bn=bn,
                                  tanh=geti(opt, "tanh", 0) == 1))
            else:
                idx = b.add(S.Lstm(output, bn=bn))
        elif name == "crnn":
            idx = b.add(S.Crnn(geti(opt, "output_filters", 1),
                               geti(opt, "hidden_filters", 1),
                               act=opt.get("activation", "logistic"),
                               bn=geti(opt, "batch_normalize", 0) == 1,
                               shortcut=geti(opt, "shortcut", 0) == 1))
        elif name == "dropout":
            idx = b.dropout(getf(opt, "probability", 0.5))
        elif name in ("yolo", "region", "detection"):
            head = dict(opt)
            head["_type"] = name
            if name == "detection":
                mask = ()  # v1 grid head: no anchors
            elif "mask" in opt:
                mask = tuple(int(x) for x in opt["mask"].split(","))
            else:
                mask = tuple(range(geti(opt, "num", 5)))
            heads.append(head)
            idx = b.detect(mask)
        elif name == "avgpool":
            idx = b.add(S.GlobalAvgPool())
        elif name == "softmax":
            if "tree" in opt:
                raise ValueError(
                    "[softmax] tree= (YOLO9000 classifier tree) is handled "
                    "through the region/tree pipeline (models/tree.py), "
                    "not as a bare softmax layer")
            if float(opt.get("spatial", 0)):
                raise ValueError("[softmax] spatial=1 is not supported")
            idx = b.add(S.Softmax(geti(opt, "groups", 1),
                                  getf(opt, "temperature", 1.0)))
        elif name == "local":
            # parse_local (parser.c:130): pad is the raw pixel amount
            idx = b.add(S.Local(geti(opt, "filters", 1),
                                geti(opt, "size", 1),
                                geti(opt, "stride", 1),
                                geti(opt, "pad", 0),
                                act=opt.get("activation", "logistic")))
        elif name == "deconvolutional":
            # parse_deconvolutional (parser.c:151): pad=1 -> size//2
            size = geti(opt, "size", 1)
            if "padding" in opt and "pad" not in opt:
                pad = geti(opt, "padding", 0)
            elif geti(opt, "pad", 0):
                pad = size // 2
            else:
                pad = 0
            idx = b.add(S.Deconv(geti(opt, "filters", 1), size,
                                 geti(opt, "stride", 1), pad,
                                 bn=geti(opt, "batch_normalize", 0) == 1,
                                 act=opt.get("activation", "logistic")))
        elif name == "crop":
            idx = b.add(S.Crop(geti(opt, "crop_height", 1),
                               geti(opt, "crop_width", 1),
                               flip=geti(opt, "flip", 0) == 1,
                               noadjust=geti(opt, "noadjust", 0) == 1))
        elif name == "normalization":
            idx = b.add(S.LRN(geti(opt, "size", 5),
                              getf(opt, "alpha", 1e-4),
                              getf(opt, "beta", 0.75),
                              getf(opt, "kappa", 1.0)))
        elif name == "l2norm":
            idx = b.add(S.L2Norm())
        elif name == "logistic":
            idx = b.add(S.Logistic())
        elif name == "cost":
            continue  # train-time only; not a runtime layer in darknet either
        else:
            raise ValueError(f"unsupported cfg section [{name}]")
        dk_to_spec.append(idx)
    specs = b.specs()
    S.validate(specs)
    return specs, net, heads


def parse_cfg_file(path: str):
    with open(path) as f:
        return parse_cfg(f.read())

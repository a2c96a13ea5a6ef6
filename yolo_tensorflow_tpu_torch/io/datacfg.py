"""Darknet ``.data`` key-value config files.

The C entry points take a ``.data`` file as their first argument and pull
per-command keys out of it: detector train reads ``train``/``backup``
(examples/detector.c:9-10), detector valid reads ``valid``/``names``/
``results``/``eval``/``map`` (examples/detector.c:238-258), test reads
``names`` (detector.c:565), and the classifier flows read ``labels``/
``train``/``valid``/``backup``/``classes``/``top``
(examples/classifier.c:46-52,178-181).

Parsing transcribes ``read_data_cfg`` (src/option_list.c:7): each line is
darknet-``strip``ped (src/utils.c:302 — EVERY space/tab/newline removed,
anywhere in the line, so values can never contain whitespace), lines whose
first remaining char is ``\\0``/``#``/``;`` are skipped, and ``read_option``
(option_list.c:50) splits on the FIRST ``=``; a line with no ``=`` (or one
ending in ``=``) is the C's "could parse" error. Duplicate keys keep the
first occurrence (option_find walks the list front-to-back).
"""

from __future__ import annotations

import sys

# detector.c's eval= dispatch (validate_detector:258-266): which result
# writer the valid flow uses
EVAL_TYPES = ("voc", "coco", "imagenet")


class DataCfgError(ValueError):
    pass


def read_data_cfg(path: str) -> dict:
    """Parse a darknet .data file into {key: value} (all strings)."""
    opts: dict = {}
    with open(path) as f:
        for nu, line in enumerate(f, 1):
            # darknet strip(): remove every ' ', '\t', '\n' in the line
            s = line.replace(" ", "").replace("\t", "").replace("\n", "")
            if not s or s[0] in "#;":
                continue
            eq = s.find("=")
            if eq < 0 or eq == len(s) - 1:
                # "Config file error line %d, could parse: %s" — the C
                # prints and continues; we fail loudly (a typoed key would
                # otherwise silently fall back to defaults)
                raise DataCfgError(
                    f"{path}:{nu}: could not parse: {line.rstrip()!r} "
                    "(expected key=value)")
            opts.setdefault(s[:eq], s[eq + 1:])
    return opts


def apply_data_cfg(args, command: str) -> dict:
    """Populate argparse ``args`` from ``args.data`` for ``command``.

    CLI flags win: a key only lands where the corresponding flag still has
    its parser default. Returns the parsed dict (empty when no --data).
    """
    if not getattr(args, "data", None):
        return {}
    opts = read_data_cfg(args.data)

    def fill(attr, value, default=None):
        if value is not None and getattr(args, attr, None) == default:
            setattr(args, attr, value)

    # names: detector files say `names`, classifier files say `labels`;
    # get_metadata (option_list.c:34) accepts either, names first
    names = opts.get("names") or opts.get("labels")
    fill("names", names)

    if command == "train":
        fill("list", opts.get("train"))
        fill("val_list", opts.get("valid"))
        fill("ckpt_dir", opts.get("backup"), default="ckpts")
    elif command == "eval":
        fill("list", opts.get("valid") or opts.get("train"))
        if "top" in opts:
            fill("top", int(opts["top"]), default=5)
        # results= names the output dir (detector.c:240 prefix). The C
        # always writes result files in valid mode; we only turn the
        # writer on when the file carries the key explicitly.
        fill("write_results", opts.get("results"))
        ev = opts.get("eval")
        if ev is not None and ev not in EVAL_TYPES:
            raise DataCfgError(f"eval={ev!r}: expected one of {EVAL_TYPES}")
        if ev == "coco" and not getattr(args, "imagenet_results", False):
            args.coco_results = True
        elif ev == "imagenet" and not getattr(args, "coco_results", False):
            args.imagenet_results = True

    # classes= sanity: the C trusts it for array sizing; we derive the
    # count from the names file, so a mismatch means a broken .data
    if "classes" in opts and names:
        try:
            with open(names) as f:
                n_names = sum(1 for line in f if line.strip())
            if int(opts["classes"]) != n_names:
                print(f"warning: {args.data}: classes={opts['classes']} "
                      f"but {names} lists {n_names} names",
                      file=sys.stderr)
        except OSError:
            pass  # the names-file open error surfaces downstream
    return opts
